// mlt-logd — native log collector service.
//
// Reference analog: the Go log-collector (server/log-collector/pkg/services/
// logcollector/server.go — StartLog :205 spawns a goroutine streaming pod
// logs to files :731/:880; GetLogs :333 streams chunks back; file state
// store; monitorLogCollection :1087 resumes after restart). Re-designed in
// C++ (Go is not a target in this build): a thread-per-connection TCP
// server with a line-oriented protocol, tailer threads that follow source
// files (pod log files / pipes) into a durable store directory, and a file
// state record so collection resumes after restart.
//
// Protocol (text header lines, binary payloads):
//   START <project> <uid> <src_path>\n          -> OK\n
//   STARTCMD <project> <uid> <nbytes>\n<cmd>    -> OK\n   (stream a
//       subprocess's stdout, e.g. "kubectl logs -f <pod> -n <ns>" — the
//       pod-log API equivalent of the reference's streaming goroutine)
//   APPEND <project> <uid> <nbytes>\n<bytes>    -> OK\n
//   GET <project> <uid> <offset> <max>\n        -> OK <n>\n<bytes>
//   SIZE <project> <uid>\n                      -> OK <n>\n
//   STOP <project> <uid>\n                      -> OK\n
//   LIST\n                                      -> OK <k>\n<project>/<uid>\n...
//   PING\n                                      -> OK\n
// Errors: ERR <message>\n

#include <arpa/inet.h>
#include <dirent.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <poll.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

std::string g_store_dir = "/tmp/mlt-logs";
// STARTCMD runs shell commands as the daemon user, so it is OFF unless a
// shared token is configured (--cmd-token / MLT_LOGD_CMD_TOKEN) and each
// STARTCMD presents it — without this gate any local process could use the
// unauthenticated localhost socket as an arbitrary-command service
std::string g_cmd_token;
std::atomic<bool> g_running{true};

struct Tailer {
  std::string project, uid, src;
  bool is_command = false;  // src is a shell command whose stdout we stream
  pid_t child_pid = -1;     // command tailer's subprocess (for STOP)
  std::thread thread;
  std::atomic<bool> stop{false};
  std::atomic<bool> finished{false};  // set by tail_loop on exit
};

std::mutex g_tailers_mu;
std::map<std::string, Tailer*> g_tailers;  // key: project/uid
// stopped tailers park here until exit — their detached threads may still
// read the stop flag, so they must outlive the map entry
std::vector<Tailer*> g_stopped;

std::string key_of(const std::string& project, const std::string& uid) {
  return project + "/" + uid;
}

bool valid_component(const std::string& s) {
  if (s.empty() || s.size() > 256) return false;
  for (char c : s) {
    if (!(isalnum(static_cast<unsigned char>(c)) || c == '-' || c == '_' ||
          c == '.'))
      return false;
    }
  if (s == "." || s == "..") return false;
  return true;
}

std::string dest_path(const std::string& project, const std::string& uid) {
  return g_store_dir + "/" + project + "/" + uid;
}

void ensure_parent(const std::string& path) {
  std::string dir = path.substr(0, path.rfind('/'));
  std::string part;
  std::stringstream ss(dir);
  std::string cur;
  for (size_t i = 0; i < dir.size(); ++i) {
    cur += dir[i];
    if (dir[i] == '/' || i == dir.size() - 1) {
      if (cur != "/") mkdir(cur.c_str(), 0755);
    }
  }
}

// state store: one record file per active tail so restart resumes
// (reference: statestore/file)
std::string state_path(const std::string& project, const std::string& uid) {
  return g_store_dir + "/.state/" + project + "__" + uid;
}

void write_state(const std::string& project, const std::string& uid,
                 const std::string& src) {
  std::string path = state_path(project, uid);
  ensure_parent(path);
  FILE* f = fopen(path.c_str(), "w");
  if (f) {
    fprintf(f, "%s\n%s\n%s\n", project.c_str(), uid.c_str(), src.c_str());
    fclose(f);
  }
}

void remove_state(const std::string& project, const std::string& uid) {
  unlink(state_path(project, uid).c_str());
  unlink((state_path(project, uid) + ".cmd").c_str());
}

// commands may be long and contain newlines — they live whole in a
// sidecar file, never inline in the line-based state record
void write_command_file(const std::string& project, const std::string& uid,
                        const std::string& command) {
  std::string path = state_path(project, uid) + ".cmd";
  ensure_parent(path);
  FILE* f = fopen(path.c_str(), "wb");
  if (f) {
    fwrite(command.data(), 1, command.size(), f);
    fclose(f);
  }
}

bool read_command_file(const std::string& project, const std::string& uid,
                       std::string* command) {
  std::string path = state_path(project, uid) + ".cmd";
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  char buf[4096];
  command->clear();
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0)
    command->append(buf, n);
  fclose(f);
  return true;
}

int spawn_command(const std::string& command, pid_t* child_pid) {
  // fork/exec with our own pipe (instead of popen) so STOP can SIGTERM
  // the child by pid — a quiet `kubectl logs -f` would otherwise never
  // notice the reader went away and leak forever
  int fds[2];
  if (pipe(fds) != 0) return -1;
  pid_t pid = fork();
  if (pid < 0) {
    close(fds[0]);
    close(fds[1]);
    return -1;
  }
  if (pid == 0) {
    dup2(fds[1], 1);
    dup2(fds[1], 2);
    close(fds[0]);
    close(fds[1]);
    execl("/bin/sh", "sh", "-c", command.c_str(),
          static_cast<char*>(nullptr));
    _exit(127);
  }
  close(fds[1]);
  *child_pid = pid;
  return fds[0];
}

void command_tail_loop(Tailer* t) {
  // stream a subprocess's stdout into the store (pod-log streaming: the
  // command is typically `kubectl logs -f <pod> -n <ns>`, which carries
  // the cluster auth the daemon itself does not need to speak)
  std::string dest = dest_path(t->project, t->uid);
  ensure_parent(dest);
  FILE* out = fopen(dest.c_str(), "ab");
  if (!out) {
    t->finished.store(true);
    return;
  }
  pid_t pid = -1;
  int fd = spawn_command(t->src, &pid);
  if (fd < 0) {
    fclose(out);
    t->finished.store(true);
    return;
  }
  t->child_pid = pid;
  char buf[64 * 1024];
  while (!t->stop.load() && g_running.load()) {
    struct pollfd pfd = {fd, POLLIN, 0};
    int ready = poll(&pfd, 1, 200);
    if (ready < 0) break;
    if (ready == 0) continue;
    ssize_t n = read(fd, buf, sizeof(buf));
    if (n <= 0) break;  // command exited (pod gone / stream closed)
    fwrite(buf, 1, static_cast<size_t>(n), out);
    fflush(out);
  }
  close(fd);
  // reap the child: TERM, short grace, then KILL
  kill(pid, SIGTERM);
  for (int i = 0; i < 20; ++i) {
    if (waitpid(pid, nullptr, WNOHANG) != 0) {
      pid = -1;
      break;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  if (pid > 0) {
    kill(pid, SIGKILL);
    waitpid(pid, nullptr, 0);
  }
  fclose(out);
  t->finished.store(true);
}

void tail_loop(Tailer* t) {
  std::string dest = dest_path(t->project, t->uid);
  ensure_parent(dest);
  FILE* out = fopen(dest.c_str(), "ab");
  if (!out) {
    t->finished.store(true);
    return;
  }
  // resume from how much we already copied
  long copied = ftell(out);
  char buf[64 * 1024];
  int idle_ms = 0;
  while (!t->stop.load() && g_running.load()) {
    FILE* in = fopen(t->src.c_str(), "rb");
    if (!in) {
      std::this_thread::sleep_for(std::chrono::milliseconds(200));
      idle_ms += 200;
      if (idle_ms > 60 * 60 * 1000) break;  // source never appeared
      continue;
    }
    fseek(in, copied, SEEK_SET);
    size_t n = fread(buf, 1, sizeof(buf), in);
    fclose(in);
    if (n > 0) {
      fwrite(buf, 1, n, out);
      fflush(out);
      copied += static_cast<long>(n);
      idle_ms = 0;
    } else {
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
      idle_ms += 100;
    }
  }
  fclose(out);
  t->finished.store(true);
}

void start_tail(const std::string& project, const std::string& uid,
                const std::string& src, bool persist_state,
                bool is_command = false) {
  std::lock_guard<std::mutex> lock(g_tailers_mu);
  std::string key = key_of(project, uid);
  auto it = g_tailers.find(key);
  if (it != g_tailers.end()) {
    // a tailer that exited (e.g. idle timeout) must not block a new START;
    // finished == true guarantees tail_loop returned, so join is instant
    if (!it->second->finished.load()) return;
    it->second->thread.join();
    delete it->second;
    g_tailers.erase(it);
  }
  Tailer* t = new Tailer();
  t->project = project;
  t->uid = uid;
  t->src = src;
  t->is_command = is_command;
  t->thread = std::thread(is_command ? command_tail_loop : tail_loop, t);
  g_tailers[key] = t;
  if (persist_state) {
    if (is_command) {
      write_command_file(project, uid, src);
      write_state(project, uid, "cmd:@");
    } else {
      write_state(project, uid, "file:" + src);
    }
  }
}

void resume_from_state() {
  std::string dir = g_store_dir + "/.state";
  DIR* d = opendir(dir.c_str());
  if (!d) return;
  struct dirent* e;
  while ((e = readdir(d)) != nullptr) {
    if (e->d_name[0] == '.') continue;
    FILE* f = fopen((dir + "/" + e->d_name).c_str(), "r");
    if (!f) continue;
    char project[512], uid[512], src[4096];
    if (fgets(project, sizeof(project), f) && fgets(uid, sizeof(uid), f) &&
        fgets(src, sizeof(src), f)) {
      auto strip = [](char* s) {
        size_t len = strlen(s);
        while (len && (s[len - 1] == '\n' || s[len - 1] == '\r'))
          s[--len] = 0;
      };
      strip(project);
      strip(uid);
      strip(src);
      std::string source = src;
      bool is_command = false;
      if (source.rfind("cmd:", 0) == 0) {
        is_command = true;
        if (!read_command_file(project, uid, &source)) {
          fclose(f);
          continue;  // sidecar missing — nothing safe to run
        }
      } else if (source.rfind("file:", 0) == 0) {
        source = source.substr(5);
      }
      start_tail(project, uid, source, false, is_command);
      fprintf(stderr, "resumed log collection %s/%s <- %s\n", project, uid,
              src);
    }
    fclose(f);
  }
  closedir(d);
}

bool read_line(int fd, std::string* line) {
  line->clear();
  char c;
  while (true) {
    ssize_t n = recv(fd, &c, 1, 0);
    if (n <= 0) return false;
    if (c == '\n') return true;
    *line += c;
    if (line->size() > 16384) return false;
  }
}

bool read_exact(int fd, char* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = recv(fd, buf + got, n - got, 0);
    if (r <= 0) return false;
    got += static_cast<size_t>(r);
  }
  return true;
}

void send_all(int fd, const char* buf, size_t n) {
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = send(fd, buf + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) return;
    sent += static_cast<size_t>(r);
  }
}

void send_str(int fd, const std::string& s) { send_all(fd, s.data(), s.size()); }

void handle_conn(int fd) {
  std::string line;
  while (read_line(fd, &line)) {
    std::istringstream iss(line);
    std::string cmd;
    iss >> cmd;
    if (cmd == "PING") {
      send_str(fd, "OK\n");
    } else if (cmd == "START") {
      std::string project, uid, src;
      iss >> project >> uid >> src;
      if (!valid_component(project) || !valid_component(uid) || src.empty()) {
        send_str(fd, "ERR bad arguments\n");
        continue;
      }
      start_tail(project, uid, src, true);
      send_str(fd, "OK\n");
    } else if (cmd == "STARTCMD") {
      std::string project, uid, token;
      long nbytes = 0;
      iss >> project >> uid >> token >> nbytes;
      if (!valid_component(project) || !valid_component(uid) || nbytes <= 0 ||
          nbytes > 65536) {
        send_str(fd, "ERR bad arguments\n");
        continue;
      }
      std::vector<char> cmdbuf(static_cast<size_t>(nbytes));
      if (!read_exact(fd, cmdbuf.data(), cmdbuf.size())) break;
      if (g_cmd_token.empty() || token != g_cmd_token) {
        send_str(fd, "ERR command streaming disabled (set --cmd-token "
                     "and present it)\n");
        continue;
      }
      start_tail(project, uid, std::string(cmdbuf.begin(), cmdbuf.end()),
                 true, true);
      send_str(fd, "OK\n");
    } else if (cmd == "APPEND") {
      std::string project, uid;
      long nbytes = 0;
      iss >> project >> uid >> nbytes;
      if (!valid_component(project) || !valid_component(uid) || nbytes < 0 ||
          nbytes > (64L << 20)) {
        send_str(fd, "ERR bad arguments\n");
        continue;
      }
      std::vector<char> buf(static_cast<size_t>(nbytes));
      if (nbytes && !read_exact(fd, buf.data(), buf.size())) break;
      std::string dest = dest_path(project, uid);
      ensure_parent(dest);
      FILE* out = fopen(dest.c_str(), "ab");
      if (!out) {
        send_str(fd, "ERR open failed\n");
        continue;
      }
      fwrite(buf.data(), 1, buf.size(), out);
      fclose(out);
      send_str(fd, "OK\n");
    } else if (cmd == "GET") {
      std::string project, uid;
      long offset = 0, max = -1;
      iss >> project >> uid >> offset >> max;
      if (!valid_component(project) || !valid_component(uid)) {
        send_str(fd, "ERR bad arguments\n");
        continue;
      }
      FILE* in = fopen(dest_path(project, uid).c_str(), "rb");
      if (!in) {
        send_str(fd, "OK 0\n");
        continue;
      }
      fseek(in, 0, SEEK_END);
      long size = ftell(in);
      if (offset > size) offset = size;
      long n = size - offset;
      if (max >= 0 && n > max) n = max;
      std::vector<char> buf(static_cast<size_t>(n));
      fseek(in, offset, SEEK_SET);
      size_t got = fread(buf.data(), 1, buf.size(), in);
      fclose(in);
      char header[64];
      snprintf(header, sizeof(header), "OK %zu\n", got);
      send_str(fd, header);
      send_all(fd, buf.data(), got);
    } else if (cmd == "SIZE") {
      std::string project, uid;
      iss >> project >> uid;
      struct stat st;
      long size = 0;
      if (valid_component(project) && valid_component(uid) &&
          stat(dest_path(project, uid).c_str(), &st) == 0)
        size = st.st_size;
      char header[64];
      snprintf(header, sizeof(header), "OK %ld\n", size);
      send_str(fd, header);
    } else if (cmd == "STOP") {
      std::string project, uid;
      iss >> project >> uid;
      {
        std::lock_guard<std::mutex> lock(g_tailers_mu);
        auto it = g_tailers.find(key_of(project, uid));
        if (it != g_tailers.end()) {
          it->second->stop.store(true);
          it->second->thread.detach();
          g_stopped.push_back(it->second);
          g_tailers.erase(it);
        }
      }
      remove_state(project, uid);
      send_str(fd, "OK\n");
    } else if (cmd == "LIST") {
      std::lock_guard<std::mutex> lock(g_tailers_mu);
      std::vector<std::string> active;
      for (auto it = g_tailers.begin(); it != g_tailers.end();) {
        if (it->second->finished.load()) {  // reap exited tailers
          it->second->thread.join();
          delete it->second;
          it = g_tailers.erase(it);
        } else {
          active.push_back(it->first);
          ++it;
        }
      }
      char header[64];
      snprintf(header, sizeof(header), "OK %zu\n", active.size());
      send_str(fd, header);
      for (auto& k : active) send_str(fd, k + "\n");
    } else {
      send_str(fd, "ERR unknown command\n");
    }
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = 8766;
  for (int i = 1; i < argc; ++i) {
    std::string arg = argv[i];
    if (arg == "--port" && i + 1 < argc) port = atoi(argv[++i]);
    if (arg == "--store-dir" && i + 1 < argc) g_store_dir = argv[++i];
    if (arg == "--cmd-token" && i + 1 < argc) g_cmd_token = argv[++i];
  }
  if (g_cmd_token.empty()) {
    const char* env_token = getenv("MLT_LOGD_CMD_TOKEN");
    if (env_token) g_cmd_token = env_token;
  }
  signal(SIGPIPE, SIG_IGN);
  ensure_parent(g_store_dir + "/x");
  resume_from_state();

  // CLOEXEC: command tailers popen() subprocesses that must NOT inherit
  // the listening socket (an inherited fd would block rebinding the port
  // after a daemon restart while a streamed command still runs)
  int srv = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    fprintf(stderr, "bind failed on port %d: %s\n", port, strerror(errno));
    return 1;
  }
  listen(srv, 64);
  fprintf(stderr, "mlt-logd listening on 127.0.0.1:%d store=%s\n", port,
          g_store_dir.c_str());
  while (g_running.load()) {
    int fd = accept4(srv, nullptr, nullptr, SOCK_CLOEXEC);
    if (fd < 0) continue;
    std::thread(handle_conn, fd).detach();
  }
  return 0;
}
